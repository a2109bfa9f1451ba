"""Streaming FASTA/FASTQ reader with exact kseq record semantics.

The reference vendors the *old, character-based* kseq (ref: src/kseq.h:170-208),
whose observable behavior this reimplements faithfully:

  * any bytes before the first '>' or '@' CHARACTER are skipped (not just
    line starts — a headerless file like demo/target2.fa yields no records);
  * a record's name runs to the first whitespace; the rest of the header
    line is the comment;
  * sequence bytes accumulate until the next '>', '+' or '@' character
    ANYWHERE in the stream (not just at line starts), keeping only
    isgraph() bytes (33..126) — so spaces, digits-with-spaces NCBI
    formatting, and newlines inside the sequence are handled exactly like
    the reference (ref: src/kseq.h:182-191);
  * '+' starts a quality block: the rest of the '+' line is skipped, then
    bytes with 33 <= c <= 127 count toward the quality until it reaches the
    sequence length, after which exactly one extra byte is consumed
    (ref: src/kseq.h:197-205);
  * a truncated quality (EOF first) is kseq's -2: iteration stops, exactly
    like the reference CLI's `while (kseq_read(...) >= 0)` loop
    (ref: src/main.c:462).

Transparently handles gzip input (ref: KSEQ_INIT(gzFile, gzread),
src/main.c:40).
"""

from __future__ import annotations

import gzip
import re
from dataclasses import dataclass
from typing import Iterator

import numpy as np

_TERM_RE = re.compile(rb"[>+@]")
_HDR_RE = re.compile(rb"[>@]")
_WS_RE = re.compile(rb"[ \t\v\f\r\n]")
# delete every byte outside isgraph() (33..126) from sequence spans
_NONGRAPH = bytes(b for b in range(256) if b < 33 or b > 126)
_IDENT = bytes(range(256))


@dataclass
class FastxRecord:
    name: str
    comment: str
    seq: str
    qual: str | None = None


class _Stream:
    """Buffered byte stream with regex-accelerated scans."""

    def __init__(self, f, bufsize: int = 1 << 16):
        self.f = f
        self.bufsize = bufsize
        self.buf = b""
        self.pos = 0
        self.eof = False

    def _fill(self) -> bool:
        if self.pos < len(self.buf):
            return True
        if self.eof:
            return False
        self.buf = self.f.read(self.bufsize)
        self.pos = 0
        if not self.buf:
            self.eof = True
            return False
        return True

    def getc(self) -> int:
        if not self._fill():
            return -1
        c = self.buf[self.pos]
        self.pos += 1
        return c

    def scan(self, regex) -> tuple[bytes, int]:
        """Consume bytes until a byte matching `regex`; returns
        (consumed-before-match, match-byte or -1 at EOF).  The matching
        byte is consumed."""
        parts = []
        while True:
            if not self._fill():
                return b"".join(parts), -1
            m = regex.search(self.buf, self.pos)
            if m is None:
                parts.append(self.buf[self.pos:])
                self.pos = len(self.buf)
                continue
            parts.append(self.buf[self.pos:m.start()])
            self.pos = m.end()
            return b"".join(parts), self.buf[m.start()]

    def read_quality(self, need: int) -> bytes | None:
        """kseq quality loop (ref: src/kseq.h:203-205): bytes 33..127 count
        until `need` collected, then one extra byte is consumed.  Returns
        None on EOF before completion (kseq's -2)."""
        out = []
        got = 0
        while got < need:
            if not self._fill():
                return None
            chunk = np.frombuffer(self.buf, np.uint8)[self.pos:]
            valid = (chunk >= 33) & (chunk <= 127)
            cum = np.cumsum(valid)
            k = int(np.searchsorted(cum, need - got))
            if k >= len(chunk):   # whole chunk consumed, still short
                out.append(chunk[valid].tobytes())
                got += int(cum[-1]) if len(cum) else 0
                self.pos = len(self.buf)
                continue
            take = chunk[:k + 1]
            out.append(take[valid[:k + 1]].tobytes())
            got = need
            self.pos += k + 1
        # the kseq loop's final iteration consumes exactly one extra byte
        # (usually the trailing newline; with an empty sequence it still
        # eats one byte) — EOF here is fine, lengths already match
        self.getc()
        return b"".join(out)


def _open(path: str):
    raw = open(path, "rb")
    magic = raw.read(2)
    raw.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(raw), raw
    return raw, raw


def read_fastx(path: str, bufsize: int = 1 << 16) -> Iterator[FastxRecord]:
    """Iterate records with kseq-equivalent character-level semantics."""
    f, raw = _open(path)
    try:
        ks = _Stream(f, bufsize)
        last_char = 0
        while True:
            if last_char == 0:
                _, c = ks.scan(_HDR_RE)
                if c == -1:
                    return
                last_char = c
            # name: up to first whitespace; comment: rest of line if any
            name, stop = ks.scan(_WS_RE)
            if stop == -1 and not name:
                return
            comment = b""
            if stop != -1 and stop != 0x0A:  # not '\n': comment follows
                # NB: the '\r' of CRLF input stays in the comment — the
                # vendored (old) kseq's ks_getuntil(ks, '\n', ...) stops at
                # the literal '\n' with no \r stripping (ref: src/kseq.h:108,
                # :180); newer upstream kseq strips it, this version doesn't
                comment, _ = ks.scan(re.compile(rb"\n"))
            # sequence: until '>', '+' or '@' anywhere; keep isgraph only
            raw_seq, term = ks.scan(_TERM_RE)
            seq = raw_seq.translate(_IDENT, _NONGRAPH)
            last_char = term if term in (0x3E, 0x40) else 0  # '>' '@'
            if term != 0x2B:  # not '+': FASTA record
                yield FastxRecord(name.decode("latin-1"),
                                  comment.decode("latin-1"),
                                  seq.decode("latin-1"))
                if term == -1:
                    return
                continue
            # FASTQ: skip the rest of the '+' line
            _, nl = ks.scan(re.compile(rb"\n"))
            if nl == -1:
                # kseq -2: truncated; the reference loop stops here
                return
            qual = ks.read_quality(len(seq))
            if qual is None:
                return  # kseq -2 (truncated quality)
            yield FastxRecord(name.decode("latin-1"),
                              comment.decode("latin-1"),
                              seq.decode("latin-1"),
                              qual.decode("latin-1"))
    finally:
        try:
            f.close()
        finally:
            if raw is not f:
                raw.close()


def read_fastx_native(path: str, batch: int = 4096) -> Iterator[FastxRecord]:
    """Native C++ reader (ssw_tpu_torch/native/fastio.cpp); kseq-equivalent.
    Raises ImportError when the native library is unavailable."""
    import ctypes

    import numpy as np

    from ssw_tpu_torch.native import build as native_build

    lib = native_build.load()
    if lib is None:
        raise ImportError("native fastio unavailable")
    h = lib.sswtpu_fastx_open(path.encode())
    if not h:
        raise OSError(f"cannot open {path}")
    try:
        while True:
            n = lib.sswtpu_fastx_batch(h, batch)
            if n == 0:
                break
            size = lib.sswtpu_fastx_arena_size(h)
            arena = ctypes.string_at(lib.sswtpu_fastx_arena(h), size)
            offs = np.ctypeslib.as_array(
                ctypes.cast(lib.sswtpu_fastx_offsets(h),
                            ctypes.POINTER(ctypes.c_int64)),
                shape=(int(n) * 8,)).copy()
            for i in range(int(n)):
                o = offs[i * 8: i * 8 + 8]
                name = arena[o[0]:o[0] + o[1]].decode("latin-1")
                comment = arena[o[2]:o[2] + o[3]].decode("latin-1")
                seq = arena[o[4]:o[4] + o[5]].decode("latin-1")
                qual = (None if o[6] < 0
                        else arena[o[6]:o[6] + o[7]].decode("latin-1"))
                yield FastxRecord(name, comment, seq, qual)
    finally:
        lib.sswtpu_fastx_close(h)


def read_fastx_auto(path: str) -> Iterator[FastxRecord]:
    """Native reader when available, pure-Python otherwise."""
    try:
        yield from read_fastx_native(path)
    except ImportError:
        yield from read_fastx(path)


def read_fastx_all(path: str) -> list[FastxRecord]:
    return list(read_fastx_auto(path))
