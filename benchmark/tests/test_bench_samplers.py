"""The frozen samplers give tools/make_data.py's bytes for its seeds, and
the traffic is a function of --seed alone."""

import gzip
import importlib.util
import os

import numpy as np

from conftest import ROOT, small


def make_data():
    spec = importlib.util.spec_from_file_location(
        "make_data_under_test", os.path.join(ROOT, "tools", "make_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_illumina_sampler_is_make_data(tmp_path):
    from benchmark import gen

    md = make_data()
    base = md.load_fasta_seq(md.ONE_M)
    assert gen.load_fasta_seq(os.path.join(ROOT, "benchmark", "data",
                                           "1M.fa")) == base
    theirs = tmp_path / "theirs.fastq.gz"
    md.make_reads(str(theirs), base, n_reads=60)
    ours = tmp_path / "ours.fastq.gz"
    gen.write_fastq(str(ours), gen.illumina_reads(
        base, 60, np.random.default_rng(100_000)), gz=True)
    with gzip.open(theirs) as a, gzip.open(ours) as b:
        assert a.read() == b.read()


def test_iontorrent_sampler_is_make_data(tmp_path):
    from benchmark import gen

    md = make_data()
    md.make_iontorrent(str(tmp_path / "ref.fa"), str(tmp_path / "ion.fq"))
    rng = np.random.default_rng(4_938_920)
    genome = gen.uniform_genome(4_938_920, rng)
    gen.write_fasta(str(tmp_path / "ref2.fa"), "ecoli_synth\t4938920bp",
                    genome)
    gen.write_fastq(str(tmp_path / "ion2.fq"),
                    gen.iontorrent_reads(genome, 1000, rng), gz=False)
    for a, b in (("ref.fa", "ref2.fa"), ("ion.fq", "ion2.fq")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()


def test_ion_cells_use_make_data_lengths(tmp_path):
    """Every seed asks for make_data's 1,000 read lengths, in its own
    order."""
    from benchmark import gen, plugins

    cfg, _ = small("iontorrent_5M.batch")
    t = plugins.make_target(cfg, str(tmp_path))
    a = plugins.sample_reads(cfg, t, 1000, gen.rng_for(5, 1, 0))
    b = plugins.sample_reads(cfg, t, 1000, gen.rng_for(6, 1, 0))
    la, lb = [len(s) for _, s, _ in a], [len(s) for _, s, _ in b]
    assert sorted(la) == sorted(lb) == sorted(t["lengths"])
    assert la != lb


def test_same_seed_same_traffic_other_seed_other(tmp_path):
    from benchmark import gen, plugins

    cfg, traffic = small("illumina_1M.batch")
    t = plugins.make_target(cfg, str(tmp_path))
    big = 2 ** 31 + 12345
    one = plugins.sample_reads(cfg, t, 8, gen.rng_for(big, 1, 0))
    assert one == plugins.sample_reads(cfg, t, 8, gen.rng_for(big, 1, 0))
    assert one != plugins.sample_reads(cfg, t, 8, gen.rng_for(big + 1, 1, 0))
    order = np.arange(len(t["seq"]) - 200)
    r1, s1 = gen.local_pairs(t["seq"], order, 0, 16, gen.rng_for(big, 2, 0),
                             100, 0.005, 1024)
    r2, s2 = gen.local_pairs(t["seq"], order, 0, 16, gen.rng_for(big, 2, 0),
                             100, 0.005, 1024)
    assert (r1 == r2).all() and (s1 == s2).all()
    g = np.frombuffer(t["seq"], dtype=np.uint8)
    for r, s, p in zip(r1, s1, order[:16]):
        assert s <= p and p + 100 <= s + 1024
        assert (r != g[p:p + 100]).sum() <= 5
