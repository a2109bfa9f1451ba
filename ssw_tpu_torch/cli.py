"""`ssw_test`-compatible command line driver (ref: src/main.c:395-547),
running the PyTorch/CUDA pipeline.

Same options and byte-identical stdout as the reference binary:
  -m/-x/-o/-e penalties, -p protein, -a matrix file, -c cigar path,
  -f score filter, -r reverse complement, -s SAM, -h SAM header.

Implementation differences (documented):
  * reads are aligned in device batches instead of one pair at a time, and
    the target file is parsed once instead of re-read from disk per read
    (ref: src/main.c:493); output is re-ordered to the reference's
    read-major order before emission;
  * the reference's argv refactor leaks option-value characters back into
    flag scanning (e.g. `-a blosum62.txt` accidentally toggles -s from the
    's' in the filename, ref: src/main.c:254-304); parse_args reproduces
    those semantics bug-for-bug through a model of the packed Linux argv
    buffer (see its docstring), stopping only where the C program would
    read past argv into envp.
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import sys
import time

from ssw_tpu_torch import pipeline
from ssw_tpu_torch.core.encoding import (AA_TABLE, BLOSUM50, NT_TABLE, dna_matrix,
                                   encode_with_table, parse_matrix_file,
                                   reverse_complement)
from ssw_tpu_torch.io import writers
from ssw_tpu_torch.io.fastx import read_fastx_auto as read_fastx

USAGE = """
Usage: ssw_test [options] ... <target.fasta> <query.fasta>(or <query.fastq>)
Options:
\t-m N\tN is a positive integer for weight match in genome sequence alignment. [default: 2]
\t-x N\tN is a positive integer. -N will be used as weight mismatch in genome sequence alignment. [default: 2]
\t-o N\tN is a positive integer. -N will be used as the weight for the gap opening. [default: 3]
\t-e N\tN is a positive integer. -N will be used as the weight for the gap extension. [default: 1]
\t-p\tDo protein sequence alignment. Without this option, the ssw_test will do genome sequence alignment.
\t-a FILE\tFILE is either the Blosum or Pam weight matrix. [default: Blosum50]
\t-c\tReturn the alignment path.
\t-f N\tN is a positive integer. Only output the alignments with the Smith-Waterman score >= N.
\t-r\tThe best alignment will be picked between the original read alignment and the reverse complement read alignment.
\t-s\tOutput in SAM format. [default: no header]
\t-h\tIf -s is used, include header in SAM output.

"""


def _atoi(s: str) -> int:
    """C atoi: leading whitespace, optional sign, digits, junk-tolerant."""
    m = re.match(r"[ \t\n\v\f\r]*([+-]?[0-9]*)", s)
    tok = m.group(1)
    try:
        return int(tok)
    except ValueError:
        return 0


# many-target streaming bounds: when the target file exceeds one chunk,
# the CLI re-streams it per read batch in chunks of at most this many
# records / encoded bases, so memory stays O(batch + chunk) instead of
# O(targets) (the reference re-reads the target file once per READ,
# ref: src/main.c:493-531 — same bounded-memory contract, amortized over
# a whole batch here).  Module constants so tests can force tiny chunks.
TARGET_CHUNK_COUNT = 256
TARGET_CHUNK_BASES = 32 << 20
BATCH_SIZE = 2048  # reads per device batch

_VALUED = "mxoeaf"
_OPT_KEY = {"m": "match", "x": "mismatch", "o": "gap_open",
            "e": "gap_extension", "f": "filter", "a": "mat_file"}


def parse_args(argv: list[str]):
    """Bug-compatible twin of the reference's hand-rolled argv scanner
    (ref: src/main.c:248-320), byte-exact on Linux, including its quirks:

      * a valued option (-m/-x/-o/-e/-a/-f) consumes the next argument only
        when it does not start with '-' (so `-m -3` leaves the default and
        `-m1` attached style silently does nothing);
      * after consuming a value the character scan CONTINUES — first inside
        the value string (so `-a blosum62.txt` also sets -s from the 's' in
        "blosum62.txt"), and then, because the C loop indexes the original
        offset into the new argv[i] and argv strings are packed contiguously
        on the Linux stack, PAST the value's terminator into the following
        argument's bytes until a '\0' lines up.  We model the packed buffer
        exactly and stop at the end of the last argument (beyond it the C
        program reads envp — not reproducible, not goldenable);
      * the file-argument locator is an independent walk that assumes
        [option][value] pairs only when the option's FIRST letter is valued
        (`-cm 3` therefore mis-locates the files — reproduced).
    """
    opts = dict(match=2, mismatch=2, gap_open=3, gap_extension=1, filter=0,
                protein=False, path=False, reverse=False, sam=False,
                header=False, mat_file=None)
    args = list(argv)
    # the contiguous argv packing: offsets[i] = linear offset of args[i]
    offsets = []
    pos = 0
    for a in args:
        offsets.append(pos)
        pos += len(a) + 1
    buf = "\0".join(args) + "\0"

    def char_at(i: int, j: int) -> str:
        """argv[i][j] through the packed buffer (may cross terminators)."""
        p = offsets[i] + j
        return buf[p] if p < len(buf) else "\0"

    i = 0
    while i < len(args):
        if args[i].startswith("-"):
            j = 1
            while char_at(i, j) != "\0":
                ch = char_at(i, j)
                if ch in _VALUED:
                    if i + 1 < len(args) and not args[i + 1].startswith("-"):
                        val = args[i + 1]
                        # the C loop keeps its numeric j index but argv[i]
                        # now points at the VALUE, so scanning continues at
                        # position j+1 *inside the value string* (and past
                        # its terminator via the packed buffer)
                        i += 1
                        if ch == "a":
                            opts["mat_file"] = val
                        else:
                            opts[_OPT_KEY[ch]] = _atoi(val)
                elif ch == "p":
                    opts["protein"] = True
                elif ch == "c":
                    opts["path"] = True
                elif ch == "r":
                    opts["reverse"] = True
                elif ch == "s":
                    opts["sam"] = True
                elif ch == "h":
                    opts["header"] = True
                j += 1
        i += 1

    # independent file-argument walk (ref: src/main.c:306-317)
    k = 0
    while k < len(args) and args[k].startswith("-"):
        if len(args[k]) > 1 and args[k][1] in _VALUED:
            k += 2
        else:
            k += 1
    files = args[k:]
    return opts, files


def main(argv: list[str] | None = None, out=None, err=None,
         device=None) -> int:
    """Run ssw_test on `argv`.  device=None runs on the CUDA device and
    raises when there is none; device="cpu" runs the plain versions."""
    device = pipeline.resolve_device(device)
    argv = sys.argv[1:] if argv is None else argv
    out = out or sys.stdout
    err = err or sys.stderr
    opts, files = parse_args(argv)
    if len(files) < 2:
        err.write(USAGE)
        return 1

    table = NT_TABLE
    n = 5
    mat = dna_matrix(opts["match"], opts["mismatch"])
    if opts["protein"] and opts["mat_file"] is None:
        n = 24
        table = AA_TABLE
        mat = BLOSUM50
    elif opts["mat_file"] is not None:
        try:
            mat, table = parse_matrix_file(opts["mat_file"])
        except OSError:
            err.write("Failed to open the weight matrix file.\n")
            return 1
        except ValueError:
            err.write("Problem of reading the weight matrix file.\n")
            return 1
        n = mat.shape[0]

    target_path, query_path = files[0], files[1]
    for path in (target_path, query_path):
        if not os.path.exists(path):
            # the reference segfaults here (unchecked gzopen,
            # ref: src/main.c:436); fail cleanly instead
            err.write(f"Failed to open the file {path}.\n")
            return 1
    sam = opts["sam"]
    if sam and opts["header"] and opts["path"]:
        out.write("@HD\tVN:1.4\tSO:queryname\n")
        for rec in read_fastx(target_path):
            out.write(f"@SQ\tSN:{rec.name}\tLN:{len(rec.seq)}\n")
    elif sam and not opts["path"]:
        err.write("SAM format output is only available together with option -c.\n")
        sam = False

    start = time.process_time()
    # opt-in observability: SSW_TPU_PROFILE=1 prints a per-phase GCUPS
    # report to stderr after the CPU-time line and SSW_TPU_TRACE=<dir>
    # captures a torch.profiler trace
    from ssw_tpu_torch import profiling
    counter = (profiling.GcupsCounter()
               if os.environ.get("SSW_TPU_PROFILE") else None)
    with contextlib.ExitStack() as ctx:
        # contexts enter INSIDE the with so a parse failure still unwinds
        # the module-global pipeline._counter
        if counter is not None:
            ctx.enter_context(pipeline.profiled(counter))
            ctx.enter_context(
                profiling.trace(os.environ.get("SSW_TPU_TRACE")))
        with (counter.phase("parse_target") if counter
              else contextlib.nullcontext()):
            # hold the targets in memory only when they fit one chunk;
            # otherwise stream the file per read batch (bounded memory)
            gen = _target_chunks(target_path, table)
            first = next(gen, None)
            stream_targets = first is not None and next(gen, None) is not None
            if stream_targets:
                targets, enc_targets = [], []  # parsed per batch below
            else:
                targets, enc_targets = first if first else ([], [])

        rc_allowed = opts["reverse"] and n == 5
        flag = 2 if opts["path"] else 0
        filt = opts["filter"]

        batch_size = BATCH_SIZE
        batch: list = []
        # double-buffered driver: batch k+1's device work (uploads +
        # forward + speculative suboptimal, via align_batch_launch) is
        # queued BEFORE batch k's host tail (reverse downloads, traceback,
        # rendering) runs, so host and device overlap across batches.
        # launch emits no warnings, so stderr order matches the serial
        # driver exactly.
        pending = None  # (entries, per-target pends) launched, unrendered

        def render_pending(prev):
            entries, pends = prev
            per_target = complete_batch(pends, filt)
            for text in render_results(entries, targets, enc_targets,
                                       per_target, table, sam, filt, opts,
                                       err):
                out.write(text)

        def flush_batch(last=False):
            nonlocal pending
            if stream_targets:
                if batch:
                    entries = batch[:]
                    batch.clear()
                    stream_render_batch(entries, target_path, table, mat,
                                        opts, sam, filt, flag, rc_allowed,
                                        out, err, device)
                return
            prev = None
            if batch:
                entries = batch[:]
                batch.clear()
                pends = launch_batch(entries, enc_targets, mat, opts, filt,
                                     flag, rc_allowed, device)
                prev, pending = pending, (entries, pends)
            elif last:
                prev, pending = pending, None
            if prev is not None:
                render_pending(prev)
            if last and pending is not None:
                render_pending(pending)
                pending = None

        for rec in read_fastx(query_path):
            if opts["reverse"] and n == 24:
                err.write("Reverse complement alignment is not available "
                          "for protein sequences. \n")
                return 1
            entry = {"rec": rec, "num": encode_with_table(rec.seq, table)}
            if rc_allowed:
                entry["rc"] = reverse_complement(rec.seq)
                entry["num_rc"] = encode_with_table(entry["rc"], table)
            batch.append(entry)
            if len(batch) >= batch_size:
                flush_batch()
        flush_batch(last=True)

    cpu_time = time.process_time() - start
    err.write(f"CPU time: {cpu_time:f} seconds\n")
    if counter is not None:
        err.write(counter.report() + "\n")
    return 0


def _target_chunks(path, table):
    """Lazily parse the target file into ([records], [encoded]) chunks
    bounded by TARGET_CHUNK_COUNT records / TARGET_CHUNK_BASES bases."""
    chunk: list = []
    enc: list = []
    total = 0
    for rec in read_fastx(path):
        chunk.append(rec)
        e = encode_with_table(rec.seq, table)
        enc.append(e)
        total += len(e)
        if len(chunk) >= TARGET_CHUNK_COUNT or total >= TARGET_CHUNK_BASES:
            yield chunk, enc
            chunk, enc, total = [], [], 0
    if chunk:
        yield chunk, enc


def stream_render_batch(entries, target_path, table, mat, opts, sam, filt,
                        flag, rc_allowed, out, err, device):
    """Bounded-memory many-target path: re-stream the target file in
    chunks for this read batch, rendering each chunk into per-read
    buffers so stdout stays read-major/target-minor byte-exact
    (ref loop order: src/main.c:462,493).  Device work for chunk c+1 is
    launched before chunk c's host tail runs (same overlap as the batch
    driver).  Holds O(batch + chunk) sequences, never all targets."""
    bufs = [io.StringIO() for _ in entries]

    def render_chunk(prev):
        tchunk, echunk, pends = prev
        per_target = complete_batch(pends, filt)
        for bi, entry in enumerate(entries):
            for ti, t in enumerate(tchunk):
                res, res_rc = per_target[ti]
                _emit_pair(bufs[bi], err, entry, t, echunk[ti], res[bi],
                           res_rc[bi] if res_rc else None, table, sam,
                           filt, opts)

    prev = None
    for tchunk, echunk in _target_chunks(target_path, table):
        pends = launch_batch(entries, echunk, mat, opts, filt, flag,
                             rc_allowed, device)
        if prev is not None:
            render_chunk(prev)
        prev = (tchunk, echunk, pends)
    if prev is not None:
        render_chunk(prev)
    for b in bufs:
        out.write(b.getvalue())


def launch_batch(batch, enc_targets, mat, opts, filt, flag, rc_allowed,
                 device):
    """Queue the device work for every (target, strand) request of a batch
    of encoded query entries; no host<->device syncs.  Returns one
    (pend, pend_rc) per target for complete_batch."""
    reads = [b["num"] for b in batch]
    mask_lens = [len(r) // 2 for r in reads]
    pends = []
    for enc_t in enc_targets:
        req = pipeline.BatchRequest(
            reads=reads, ref=enc_t, mat=mat, gapO=opts["gap_open"],
            gapE=opts["gap_extension"], flag=flag, filters=filt,
            filterd=0, mask_len=mask_lens, score_size=2)
        pend = pipeline.align_batch_launch(req, device)
        pend_rc = None
        if rc_allowed:
            req_rc = pipeline.BatchRequest(
                reads=[b["num_rc"] for b in batch], ref=enc_t, mat=mat,
                gapO=opts["gap_open"], gapE=opts["gap_extension"],
                flag=flag, filters=filt, filterd=0, mask_len=mask_lens,
                score_size=2)
            pend_rc = pipeline.align_batch_launch(req_rc, device)
        pends.append((pend, pend_rc))
    return pends


def complete_batch(pends, filt):
    """Finish launched requests.  Under -r only the emitted strand's
    traceback runs (the losing strand's cigar is unobservable in the
    reference output, src/main.c:505-518; its reverse pass still runs for
    stderr warning parity — see pipeline.align_batch_finish)."""
    per_target = []
    for pend, pend_rc in pends:
        if pend_rc is None:
            res = pipeline.align_batch_finish(pend)
            res_rc = None
        else:
            s_f = pipeline.align_batch_scores(pend)
            s_rc = pipeline.align_batch_scores(pend_rc)
            rc_wins = (s_rc > s_f) & (s_rc >= filt)  # _emit_pair's pick
            res = pipeline.align_batch_finish(pend, detail=~rc_wins)
            res_rc = pipeline.align_batch_finish(pend_rc, detail=rc_wins)
        per_target.append((res, res_rc))
    return per_target


def render_results(batch, targets, enc_targets, per_target, table, sam,
                   filt, opts, err) -> list[str]:
    """Render per-read output (read-major, target-minor — the reference's
    loop order, ref: src/main.c:462,493).  Returns one string per read
    ("" when everything about the read is suppressed)."""
    rendered = []
    for bi, b in enumerate(batch):
        buf = io.StringIO()
        for ti, t in enumerate(targets):
            res, res_rc = per_target[ti]
            result = res[bi]
            result_rc = res_rc[bi] if res_rc else None
            _emit_pair(buf, err, b, t, enc_targets[ti], result, result_rc,
                       table, sam, filt, opts)
        rendered.append(buf.getvalue())
    return rendered


def _emit_pair(out, err, b, t, enc_t, result, result_rc, table, sam,
               filt, opts):
    rec = b["rec"]
    if len(b["num"]) // 2 < 15:
        # the reference prints this inside every ssw_align call (twice per
        # pair with -r, before the pair's output — ref: src/ssw.c:876-878)
        for _ in range(2 if result_rc is not None else 1):
            err.write("When maskLen < 15, the function ssw_align doesn't "
                      "return 2nd best alignment information.\n")
    if result is None:
        err.write("Warning: Alignment between the following sequences "
                  f"is failed.\nref_name: {t.name}\nread_name: "
                  f"{rec.name}\n\n")
        return
    if (result_rc is not None and result_rc.score1 > result.score1
            and result_rc.score1 >= filt):
        if result_rc.flag == 2:
            err.write("Warning: The reverse compliment alignment of the "
                      f"following sequences may miss a small part.\n"
                      f"ref_seq: {t.name}\nread_seq: {rec.name}\n\n")
        if sam:
            writers.sam_record(out, result_rc, t.name, rec.name,
                               b["rc"], rec.qual, enc_t, b["num_rc"], 1)
        else:
            writers.blast_like(out, result_rc, t.name, rec.name, t.seq,
                               b["rc"], table, 1)
    elif result.score1 > 0 and result.score1 >= filt:
        if result.flag == 2:
            err.write("Warning: The alignment of the following sequences "
                      f"may miss a small part.\nref_seq: {t.name}\n"
                      f"read_seq: {rec.name}\n\n")
        if sam:
            writers.sam_record(out, result, t.name, rec.name, rec.seq,
                               rec.qual, enc_t, b["num"], 0)
        else:
            writers.blast_like(out, result, t.name, rec.name, t.seq,
                               rec.seq, table, 0)
    elif result.score1 <= 0:
        err.write("There is no identical residue between the following "
                  f"reference and read seqeunces.\nref_name: {t.name}\n"
                  f"read_name: {rec.name}\n\n")


if __name__ == "__main__":
    sys.exit(main())
