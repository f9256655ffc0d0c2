"""Minimal reader for SentencePiece ``spiece.model`` files (no sentencepiece
library needed). Copy of ``mmdx_tpu/text/spm_reader.py``.

The reference's T5 tokenizer assets (saved by ``t5_tokenizer.save_pretrained``
into the registry's ``t5_assets/``, reference training_pipeline.py:724-729)
are a serialized ``sentencepiece.ModelProto``.  We only need the piece
inventory and scores to drive the unigram-LM Viterbi segmentation in
``T5StyleTokenizer``, so this is a ~60-line protobuf wire-format walk over:

    message ModelProto {
      repeated SentencePiece pieces = 1;      // field 1, length-delimited
      ...                                      // trainer/normalizer specs etc.
    }
    message SentencePiece {
      optional string piece = 1;               // field 1, length-delimited
      optional float  score = 2;               // field 2, 32-bit
      optional Type   type  = 3;               // field 3, varint
    }

Piece index order IS the token id (T5: <pad>=0, </s>=1, <unk>=2, ...).
"""
from __future__ import annotations

import struct
from pathlib import Path

# SentencePiece piece types (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:  # 64-bit
        pos += 8
    elif wire_type == 2:  # length-delimited
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire_type == 5:  # 32-bit
        pos += 4
    else:
        raise ValueError(f"unsupported protobuf wire type {wire_type}")
    return pos


def _parse_piece(buf: bytes) -> tuple[str, float, int]:
    piece, score, ptype = "", 0.0, NORMAL
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, pos = _read_varint(buf, pos)
            piece = buf[pos:pos + n].decode("utf-8")
            pos += n
        elif field == 2 and wire == 5:
            (score,) = struct.unpack("<f", buf[pos:pos + 4])
            pos += 4
        elif field == 3 and wire == 0:
            ptype, pos = _read_varint(buf, pos)
        else:
            pos = _skip_field(buf, pos, wire)
    return piece, score, ptype


def read_spiece_pieces(path: str | Path) -> list[tuple[str, float, int]]:
    """Parse a spiece.model -> ordered [(piece, score, type)]."""
    buf = Path(path).read_bytes()
    pieces: list[tuple[str, float, int]] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # ModelProto.pieces
            n, pos = _read_varint(buf, pos)
            pieces.append(_parse_piece(buf[pos:pos + n]))
            pos += n
        else:
            pos = _skip_field(buf, pos, wire)
    return pieces


def read_spiece_vocab(path: str | Path) -> tuple[dict[str, int], dict[int, float]]:
    """spiece.model -> (vocab {piece: id}, scores {id: log_prob}) ready for
    ``T5StyleTokenizer(vocab=..., scores=...)`` — drop-in unigram parity with
    the file's SentencePiece segmentation."""
    pieces = read_spiece_pieces(path)
    vocab = {p: i for i, (p, _, _) in enumerate(pieces)}
    scores = {i: float(s) for i, (_, s, _) in enumerate(pieces)}
    return vocab, scores


def write_spiece_model(pieces: list[tuple[str, float]], path: str | Path,
                       types: list[int] | None = None) -> Path:
    """Serialize [(piece, score)] into a minimal valid spiece.model (used by
    tests to round-trip the reader, and by the registry publisher so our
    t5_assets mirror the reference layout)."""
    out = bytearray()

    def varint(v: int) -> bytes:
        b = bytearray()
        while True:
            if v > 0x7F:
                b.append((v & 0x7F) | 0x80)
                v >>= 7
            else:
                b.append(v)
                return bytes(b)

    for i, (piece, score) in enumerate(pieces):
        body = bytearray()
        pb = piece.encode("utf-8")
        body += b"\x0a" + varint(len(pb)) + pb  # field 1 LEN
        body += b"\x15" + struct.pack("<f", float(score))  # field 2 32-bit
        ptype = types[i] if types else NORMAL
        body += b"\x18" + varint(ptype)  # field 3 varint
        out += b"\x0a" + varint(len(body)) + bytes(body)  # ModelProto.pieces
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(bytes(out))
    return path
