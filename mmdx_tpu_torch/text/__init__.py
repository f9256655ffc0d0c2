"""Host-side tokenizers: WordPiece (BERT-compatible) + T5-style subword (pure Python; the native C++ cores are not ported)."""
