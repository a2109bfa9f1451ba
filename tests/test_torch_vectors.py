"""The 211 vectors generated by driving the reference C library's public API
(tools/gen_vectors.c, tests/vectors/ssw_vectors.jsonl) through the port's
batched pipeline on device "cpu": every s_align field equal."""

import json
import os

import numpy as np
import pytest

from ssw_tpu_torch import pipeline
from ssw_tpu_torch.core.cigar import cigar_to_string

VEC_PATH = os.path.join(os.path.dirname(__file__), "vectors",
                        "ssw_vectors.jsonl")


def load_vectors():
    with open(VEC_PATH) as f:
        return [json.loads(line) for line in f if line.strip()]


VECTORS = load_vectors()


@pytest.mark.parametrize("idx", range(len(VECTORS)))
def test_vector(idx):
    v = VECTORS[idx]
    n = v["n"]
    req = pipeline.BatchRequest(
        reads=[np.array(v["read"], dtype=np.int8)],
        ref=np.array(v["ref"], dtype=np.int8),
        mat=np.array(v["mat"], dtype=np.int8).reshape(n, n),
        gapO=v["gapO"], gapE=v["gapE"], flag=v["flag"],
        filters=v["filters"], filterd=v["filterd"], mask_len=v["maskLen"],
        score_size=v["score_size"])
    r = pipeline.align_batch(req, device="cpu")[0]
    if v.get("null_result"):
        assert r is None
        return
    assert r is not None
    got = dict(score1=r.score1, score2=r.score2, ref_begin1=r.ref_begin1,
               ref_end1=r.ref_end1, read_begin1=r.read_begin1,
               read_end1=r.read_end1, ref_end2=r.ref_end2, aflag=r.flag,
               cigar=cigar_to_string(r.cigar))
    assert got == {k: v[k] for k in got}
