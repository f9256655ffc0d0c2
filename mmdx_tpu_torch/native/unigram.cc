// Native SentencePiece-unigram (Viterbi) tokenizer core (C++17, no deps) —
// the T5-side host tokenizer twin of wordpiece.cc. The reference tokenizes
// report text with the hub T5Tokenizer (a SentencePiece unigram model,
// reference backend/ml/pipelines/training_pipeline.py:980,
// inference_pipeline.py:196); mmdx_tpu/text/t5_tokenizer.py implements the
// same max-sum-of-scores Viterbi segmentation in Python, and this core is
// byte-for-byte output-identical to it (asserted in
// tests/test_native_unigram.py).
//
// The caller passes the ALREADY-NORMALIZED, dummy-prefixed, space-escaped
// sentence (leading U+2581, spaces replaced by U+2581) — normalization
// (NFKC) stays in Python where unicodedata lives. Viterbi runs over UNICODE
// CODEPOINTS (piece lengths are codepoint counts, matching the Python
// per-character dynamic program), with pieces matched as raw UTF-8 byte
// substrings.
//
// Vocab file format: spm_export_vocab TSV, "piece\tscore" per line, line
// number = id. Control/user-defined symbols (<pad>, </s>, <extra_id_N>, ...)
// are excluded from matching, like SentencePiece's trie. Unscored
// piece-per-line vocabs are NOT handled here (the Python greedy fallback
// covers them).
//
// C ABI (ctypes):
//   void* ug_create(const char* vocab_path);       // NULL on error/unscored
//   void  ug_destroy(void* h);
//   int   ug_vocab_size(void* h);
//   int   ug_encode(void* h, const char* transformed_utf8,
//                   int32_t* out_ids, int out_capacity);  // #ids or -1
#include <cstdint>
#include <cstring>
#include <fstream>
#include <limits>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kUnkPenalty = 10.0;  // SentencePiece unigram_model.cc
constexpr int32_t kUnkId = 2;         // T5 convention (<unk>)

struct Unigram {
  std::unordered_map<std::string, int32_t> pieces;  // matchable pieces
  std::vector<double> scores;                       // by id
  int32_t vocab_size = 0;
  size_t max_piece_cp = 1;  // longest piece in codepoints
  double unk_score = 0.0;
};

// number of codepoints in a UTF-8 string (bytes >= 0x80 with 10xxxxxx are
// continuations)
inline bool is_cont(unsigned char c) { return (c & 0xC0) == 0x80; }

size_t count_codepoints(const std::string& s) {
  size_t n = 0;
  for (unsigned char c : s)
    if (!is_cont(c)) ++n;
  return n;
}

}  // namespace

extern "C" {

void* ug_create(const char* vocab_path) {
  std::ifstream f(vocab_path);
  if (!f) return nullptr;
  auto* u = new Unigram();
  std::string line;
  double min_score = std::numeric_limits<double>::infinity();
  bool any_score = false;
  int32_t id = 0;
  while (std::getline(f, line)) {
    auto tab = line.find('\t');
    if (tab == std::string::npos) {
      // unscored vocab: unigram segmentation undefined -> refuse (caller
      // falls back to the Python greedy path)
      delete u;
      return nullptr;
    }
    std::string piece = line.substr(0, tab);
    double score = std::strtod(line.c_str() + tab + 1, nullptr);
    any_score = true;
    const bool control = piece.size() >= 2 && piece.front() == '<' &&
                         piece.back() == '>';
    if (!control) {
      u->pieces.emplace(piece, id);
      size_t cp = count_codepoints(piece);
      if (cp > u->max_piece_cp) u->max_piece_cp = cp;
    }
    // unk_score mins over EVERY scored line (control symbols included),
    // matching the Python path's unk_score = min(scores.values()) - penalty.
    if (score < min_score) min_score = score;
    u->scores.push_back(score);
    ++id;
  }
  if (!any_score || u->pieces.empty()) {
    delete u;
    return nullptr;
  }
  u->vocab_size = id;
  u->unk_score = min_score - kUnkPenalty;
  return u;
}

void ug_destroy(void* h) { delete static_cast<Unigram*>(h); }

int ug_vocab_size(void* h) { return static_cast<Unigram*>(h)->vocab_size; }

// Viterbi max-score segmentation over codepoints; mirrors
// T5StyleTokenizer._viterbi (strict > on score, lengths ascending, unk node
// only when no single-codepoint piece matches at a position).
int ug_encode(void* h, const char* text, int32_t* out_ids, int out_capacity) {
  const Unigram& u = *static_cast<Unigram*>(h);
  const std::string s(text);
  // codepoint byte offsets (offsets[n] == s.size())
  std::vector<size_t> off;
  off.reserve(s.size() + 1);
  for (size_t i = 0; i < s.size(); ++i)
    if (!is_cont(static_cast<unsigned char>(s[i]))) off.push_back(i);
  off.push_back(s.size());
  const size_t n = off.size() - 1;
  if (n == 0) return 0;

  const double neg = -std::numeric_limits<double>::infinity();
  std::vector<double> best(n + 1, neg);
  std::vector<int32_t> back_id(n + 1, -1);
  std::vector<size_t> back_start(n + 1, 0);
  best[0] = 0.0;
  std::string buf;
  for (size_t start = 0; start < n; ++start) {
    const double b = best[start];
    if (b == neg) continue;
    bool has_single = false;
    const size_t top = std::min(u.max_piece_cp, n - start);
    for (size_t len = 1; len <= top; ++len) {
      buf.assign(s, off[start], off[start + len] - off[start]);
      auto it = u.pieces.find(buf);
      if (it == u.pieces.end()) continue;
      if (len == 1) has_single = true;
      const double sc = b + u.scores[it->second];
      if (sc > best[start + len]) {
        best[start + len] = sc;
        back_id[start + len] = it->second;
        back_start[start + len] = start;
      }
    }
    if (!has_single) {
      const double sc = b + u.unk_score;
      if (sc > best[start + 1]) {
        best[start + 1] = sc;
        back_id[start + 1] = kUnkId;
        back_start[start + 1] = start;
      }
    }
  }

  std::vector<int32_t> rev;
  size_t pos = n;
  while (pos > 0) {
    rev.push_back(back_id[pos]);
    pos = back_start[pos];
  }
  const int count = static_cast<int>(rev.size());
  if (count > out_capacity) return -1;
  for (int i = 0; i < count; ++i) out_ids[i] = rev[count - 1 - i];
  return count;
}

}  // extern "C"
