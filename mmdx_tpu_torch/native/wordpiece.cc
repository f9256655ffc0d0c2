// Native WordPiece tokenizer core (C++17, no deps) — the host-side hot path of
// serving: every request tokenizes patient-details text before hitting the
// device (reference tokenize_patient_details, training_pipeline.py:335-342).
//
// Implements the same algorithm as mmdx_tpu/text/wordpiece.py (HF
// BertTokenizer semantics): ASCII-level basic tokenization (cleanup,
// lowercase, punctuation split) + greedy longest-match WordPiece over a vocab
// loaded from file.  Non-ASCII bytes are handled by the Python layer (it
// pre-normalizes accents); this core processes UTF-8 where multi-byte
// sequences are treated as opaque word characters, matching the Python path
// after NFD-stripping.
//
// C ABI (ctypes):
//   void*  wp_create(const char* vocab_path);
//   void   wp_destroy(void* h);
//   int    wp_encode(void* h, const char* text, int max_len,
//                    int cls_id, int sep_id, int pad_id, int unk_id,
//                    int* out_ids);           // returns max_len ids
//   int    wp_vocab_size(void* h);
//   int    wp_token_id(void* h, const char* token);  // -1 if absent

#include <cctype>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  size_t max_piece_chars = 0;
};

inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) || (c >= 91 && c <= 96) ||
         (c >= 123 && c <= 126);
}

inline bool is_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

inline bool is_control(unsigned char c) { return c < 32 && !is_space(c); }

// greedy longest-match wordpiece of one word into ids
void wordpiece(const Tokenizer& tok, const std::string& word, int unk_id,
               std::vector<int32_t>* out) {
  if (word.size() > 100) {  // HF max_input_chars_per_word
    out->push_back(unk_id);
    return;
  }
  size_t start = 0;
  std::vector<int32_t> pieces;
  std::string buf;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur = -1;
    while (start < end) {
      buf.clear();
      if (start > 0) buf = "##";
      buf.append(word, start, end - start);
      auto it = tok.vocab.find(buf);
      if (it != tok.vocab.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {
      out->push_back(unk_id);
      return;
    }
    pieces.push_back(cur);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_path) {
  std::ifstream f(vocab_path);
  if (!f.good()) return nullptr;
  auto* tok = new Tokenizer();
  std::string line;
  int32_t id = 0;
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    tok->vocab.emplace(line, id++);
    if (line.size() > tok->max_piece_chars) tok->max_piece_chars = line.size();
  }
  return tok;
}

void wp_destroy(void* h) { delete static_cast<Tokenizer*>(h); }

int wp_vocab_size(void* h) {
  return static_cast<int>(static_cast<Tokenizer*>(h)->vocab.size());
}

int wp_token_id(void* h, const char* token) {
  auto& vocab = static_cast<Tokenizer*>(h)->vocab;
  auto it = vocab.find(token);
  return it == vocab.end() ? -1 : it->second;
}

// Encode: basic tokenize (clean -> lowercase -> split punct) + wordpiece +
// [CLS]/[SEP]/pad to max_len. Returns the number of real (non-pad) ids.
int wp_encode(void* h, const char* text, int max_len, int cls_id, int sep_id,
              int pad_id, int unk_id, int32_t* out_ids) {
  const auto& tok = *static_cast<Tokenizer*>(h);
  std::vector<int32_t> ids;
  ids.reserve(max_len);

  std::string word;
  auto flush_word = [&]() {
    if (!word.empty()) {
      wordpiece(tok, word, unk_id, &ids);
      word.clear();
    }
  };

  for (const unsigned char* p = reinterpret_cast<const unsigned char*>(text);
       *p; ++p) {
    unsigned char c = *p;
    if (c == 0xEF && p[1] == 0xBF && p[2] == 0xBD) {  // U+FFFD
      p += 2;
      continue;
    }
    if (is_control(c)) continue;
    if (is_space(c)) {
      flush_word();
      continue;
    }
    if (c < 128) {
      if (is_ascii_punct(c)) {
        flush_word();
        word.push_back(static_cast<char>(c));
        flush_word();
      } else {
        word.push_back(static_cast<char>(std::tolower(c)));
      }
    } else {
      // opaque UTF-8 continuation: Python layer pre-normalizes; keep bytes
      word.push_back(static_cast<char>(c));
    }
  }
  flush_word();

  int content = max_len - 2;
  if (static_cast<int>(ids.size()) > content) ids.resize(content);
  int n = 0;
  out_ids[n++] = cls_id;
  for (int32_t id : ids) out_ids[n++] = id;
  out_ids[n++] = sep_id;
  int real = n;
  while (n < max_len) out_ids[n++] = pad_id;
  return real;
}

}  // extern "C"
