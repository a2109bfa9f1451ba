"""The port's measurement tools (ssw_tpu_torch/tools) against the JAX
package's TPU tools in tools/, on the CPU: the JAX kernels run through
pallas_call(interpret=True), the port's plain twins (the paths a CPU tensor
takes) on the same numpy inputs; every comparison is exact."""

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
import jax.numpy as jnp

from ssw_tpu_torch.ops import scan_sw
from ssw_tpu_torch.tools import kernel_lab, probe_i16, probe_swar


@pytest.fixture
def interpret(monkeypatch):
    """Every pallas_call of the JAX tools in interpret mode."""
    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **kw: real(*a, interpret=True, **kw))


# ---- probe_swar

@pytest.mark.parametrize("which", ["native", "swar"])
def test_probe_swar_chain_equals_jax(which):
    from tools import probe_swar as jax_probe

    x, y = probe_swar.inputs()  # the JAX tool's bench inputs, seed 3
    want = np.asarray(jax_probe.run(jnp.asarray(x), jnp.asarray(y), which,
                                    True))
    got = probe_swar.run(torch.as_tensor(x), torch.as_tensor(y), which)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_probe_swar_packed_max_equals_jax_and_vmaxs2():
    from tools import probe_swar as jax_probe

    rng = np.random.default_rng(9)
    a, b = (rng.integers(0, 2 ** 15, (64, 512)).astype(np.int64)
            for _ in range(2))
    c, d = (rng.integers(0, 2 ** 15, (64, 512)).astype(np.int64)
            for _ in range(2))
    pa = ((a << 16) | b).astype(np.uint32).view(np.int32)
    pb = ((c << 16) | d).astype(np.uint32).view(np.int32)
    want = np.asarray(jax_probe.packed_max(jnp.asarray(pa), jnp.asarray(pb)))
    ta, tb = torch.as_tensor(pa), torch.as_tensor(pb)
    assert np.array_equal(probe_swar.packed_max(ta, tb).numpy(), want)
    # halves below 2^15: the signed s16x2 max is the guard-bit max
    assert np.array_equal(probe_swar.run(ta, tb, "vmaxs2", 1).numpy(), want)
    probe_swar.check_exact(np.random.default_rng(0))


def test_probe_swar_forms_at_the_jax_shape():
    errs = probe_swar.exactness("cpu")
    assert set(errs) == set(probe_swar.FORMS) | {"vmaxs2_vs_swar"}
    assert not any(errs.values())


# ---- probe_i16

@pytest.mark.parametrize("name", probe_i16.REGISTRY)
def test_probe_i16_registry_equals_jax(name, interpret, monkeypatch):
    """The JAX probe's kernel, captured from its _run, on the JAX inputs
    (ones * (i + 1)) and on random halves in the int16 tier's domain,
    against the port's twin of the same name."""
    from tools import probe_i16 as jax_probe
    import jax

    seen = {}
    real_run = jax_probe._run

    def run(kernel, n_in=1, dtype="int16"):
        seen["kernel"] = kernel
        seen["out"] = np.asarray(real_run(kernel, n_in, dtype))
        return seen["out"]

    monkeypatch.setattr(jax_probe, "_run", run)
    jax_probe.PROBES[name]()
    got = probe_i16.run(name, probe_i16.registry_inputs(name))
    assert np.array_equal(got.numpy(), seen["out"])
    xs = probe_i16.random_inputs(name, 5)
    want = pl.pallas_call(seen["kernel"], out_shape=jax.ShapeDtypeStruct(
        probe_i16.SHAPE, jnp.int16))(*[jnp.asarray(x.numpy()) for x in xs])
    assert np.array_equal(probe_i16.run(name, xs).numpy(), np.asarray(want))


_NUMPY = {
    "viaddmax_s16x2": lambda a, b, c: np.maximum(a + b, c),
    "viaddmax_s16x2_relu": lambda a, b, c: np.maximum(np.maximum(a + b, c),
                                                      0),
    "vmaxs2": np.maximum,
    "vsub2": np.subtract,
    "viaddmax_s32": lambda a, b, c: np.maximum(a + b, c),
    "viaddmax_s32_relu": lambda a, b, c: np.maximum(np.maximum(a + b, c),
                                                    0),
}


@pytest.mark.parametrize("name", probe_i16.DPX)
def test_probe_i16_dpx_twin_equals_numpy(name):
    """Per half (or s32) over the tier's domain, where no add wraps."""
    for seed in (1, 2):
        xs = probe_i16.random_inputs(name, seed)
        want = _NUMPY[name](*[x.numpy().astype(np.int64) for x in xs])
        got = probe_i16.run(name, xs)
        assert got.dtype == xs[0].dtype
        assert np.array_equal(got.numpy().astype(np.int64), want)


# ---- kernel_lab

LAB_B, LAB_L, LAB_BLOCKS = 8, 64, 2


@pytest.fixture(scope="module")
def lab_inputs():
    rng = np.random.default_rng(17)
    profile, ref_blocks = kernel_lab.jax_inputs(rng, LAB_B, LAB_L,
                                                LAB_BLOCKS)
    return profile, ref_blocks, kernel_lab.from_jax(profile, ref_blocks)


def _jax_lab(variant, profile, ref_blocks):
    """tools/kernel_lab.run at B 8, L 64, 2 blocks (set_shape), its
    pallas_call in interpret mode; returns (maxcol, gmax, end_ref,
    h_best) as numpy."""
    from tools import kernel_lab as jax_lab

    jax_lab.set_shape(LAB_B, LAB_L, LAB_BLOCKS)
    decay = np.arange(LAB_L, dtype=np.int32)[None, :]
    dmg = np.broadcast_to(decay - 3, (LAB_B, LAB_L)).astype(np.int32)
    gmd = np.broadcast_to(1 - decay, (LAB_B, LAB_L)).astype(np.int32)
    maskneg = np.zeros((LAB_B, LAB_L), np.int32)
    outs = jax_lab.run(jnp.asarray(profile), jnp.asarray(ref_blocks),
                       jnp.asarray(dmg), jnp.asarray(gmd),
                       jnp.asarray(maskneg), variant)
    return [np.asarray(o) for o in outs]


def test_lab_full_equals_jax(interpret, lab_inputs):
    profile, ref_blocks, args = lab_inputs
    maxcol, gmax, end_ref, h_best = _jax_lab("full", profile, ref_blocks)
    got = kernel_lab.run("full", args)
    assert np.array_equal(got["score"].numpy(), gmax[:, 0])
    assert np.array_equal(got["end_ref"].numpy(), end_ref[:, 0])
    assert np.array_equal(got["maxcol"].numpy().astype(np.int32), maxcol)
    # h_best <-> end_read: the lowest lane holding the best at its column
    g = gmax[:, 0]
    hit = (h_best == g[:, None]) & (g[:, None] > 0)
    end_read = np.where(hit.any(1), hit.argmax(1), LAB_L - 1)
    assert np.array_equal(got["end_read"].numpy(), end_read)


@pytest.mark.parametrize("variant,jax_variant", [("lanetrack", "enc"),
                                                 ("gatescan", "r3e2")])
def test_lab_block_variants_equal_jax(variant, jax_variant, interpret,
                                      lab_inputs):
    """The JAX `enc` (and `r3e2`, enc with its gate) write one block maximum
    per 256 columns, the best and its first column; the port's lanetrack
    and gatescan twins give the same."""
    profile, ref_blocks, args = lab_inputs
    maxcol, gmax, end_ref, _ = _jax_lab(jax_variant, profile, ref_blocks)
    gate = kernel_lab.card_gate(args)
    got = kernel_lab.run(variant, args, gate=gate)
    R = LAB_BLOCKS * kernel_lab.COL_BLOCK
    bm = (got["blockmax"] if variant == "lanetrack"
          else scan_sw.blockmax_reduce(got["maxcol"], R))
    assert np.array_equal(bm.numpy(), maxcol[:, ::kernel_lab.COL_BLOCK])
    assert np.array_equal(got["score"].numpy(), gmax[:, 0])
    assert np.array_equal(got["end_ref"].numpy(), end_ref[:, 0])
    if variant == "gatescan":
        assert int(got["steps"].sum()) == LAB_B * R


def test_lab_twins_agree_where_exact(lab_inputs):
    """Variants the table compares with full give full's outputs; a full
    depth shortscan is full; notrack's rows and nodp are their own."""
    args = lab_inputs[2]
    full = kernel_lab.run("full", args)
    for v in ("noclamp", "radix4"):
        out = kernel_lab.run(v, args)
        assert all(torch.equal(out[k], full[k]) for k in full)
    lane = kernel_lab.run("lanetrack", args)
    for k in ("score", "end_ref", "end_read"):
        assert torch.equal(lane[k], full[k])
    assert kernel_lab.run("notrack", args)["rows"].shape == (LAB_B, 2,
                                                            LAB_L)
    shallow = kernel_lab.run("shortscan", args, m=0)
    assert shallow["score"].shape == full["score"].shape


def test_lab_verify_compares_every_twinned_variant(lab_inputs):
    """verify holds every variant but skeleton to a comparison (on the CPU
    its twin against itself, the kernel-run ones through the wrappers'
    plain routes), on a column slice for the twin; skeleton has none."""
    args = lab_inputs[2]
    gate = kernel_lab.card_gate(args)
    for v in kernel_lab.VARIANTS:
        err = kernel_lab.verify(v, args, m=1 if v == "shortscan" else None,
                                gate=gate, twin_cols=kernel_lab.COL_BLOCK)
        assert err == (None if v == "skeleton" else 0), (v, err)


def test_lab_grammar():
    assert kernel_lab.parse("full") == {
        "variant": "full", "m": None, "count": False, "B": 128, "L": 256,
        "blocks": 128}
    p = kernel_lab.parse("gatescan#64x512?")
    assert (p["B"], p["L"], p["count"]) == (64, 512, True)
    assert p["blocks"] == 128 * 128 * 256 // (64 * 512)
    assert kernel_lab.parse("shortscan!3")["m"] == 3
    for bad in ("maskstore", "full!2", "nostore?", "shortscan!5", "full@8"):
        with pytest.raises(ValueError):
            kernel_lab.parse(bad)
