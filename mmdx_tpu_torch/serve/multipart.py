"""Minimal multipart/form-data parser (stdlib-only; cgi was removed in 3.13).

Parses the upload format the reference's React frontend posts to
``/api/predict/`` (reference frontend/src/pages/HomePage.jsx:51-83): an
``image`` file part + a ``patient_details`` text field.
"""
from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass
class Part:
    name: str
    filename: str | None
    content_type: str | None
    data: bytes

    @property
    def text(self) -> str:
        return self.data.decode("utf-8", errors="replace")


def parse_boundary(content_type: str) -> bytes | None:
    m = re.search(r'boundary="?([^";]+)"?', content_type or "")
    return m.group(1).encode() if m else None


def parse_multipart(body: bytes, boundary: bytes) -> dict[str, Part]:
    """RFC 2046 parsing, tolerant of missing trailing CRLF."""
    delim = b"--" + boundary
    parts: dict[str, Part] = {}
    for chunk in body.split(delim):
        chunk = chunk.strip(b"\r\n")
        if not chunk or chunk == b"--":
            continue
        if b"\r\n\r\n" in chunk:
            raw_headers, data = chunk.split(b"\r\n\r\n", 1)
        else:
            raw_headers, data = chunk, b""
        headers: dict[str, str] = {}
        for line in raw_headers.split(b"\r\n"):
            if b":" in line:
                k, v = line.split(b":", 1)
                # latin-1 never raises: malformed header bytes from a broken
                # client must surface as a 400 (no matching parts), not as a
                # UnicodeDecodeError-turned-500
                headers[k.decode("latin-1").strip().lower()] = (
                    v.decode("latin-1").strip()
                )
        disp = headers.get("content-disposition", "")
        name_m = re.search(r'name="([^"]*)"', disp)
        if not name_m:
            continue
        file_m = re.search(r'filename="([^"]*)"', disp)
        parts[name_m.group(1)] = Part(
            name=name_m.group(1),
            filename=file_m.group(1) if file_m else None,
            content_type=headers.get("content-type"),
            data=data,
        )
    return parts
