"""Ion Torrent-like reads (tools/make_data.py make_iontorrent) with their
lengths fixed: every call gets the lengths of make_data's own file (its
sampler run on the genome's generator, as make_data runs it) in an order
drawn from the seed, each read at a uniform origin with substitutions at
`err`, quality 'I'.  So every seed asks for the same work."""

from benchmark import gen


def prepare(reads: dict, target: dict) -> None:
    target["lengths"] = [len(s) for _, s, _ in gen.iontorrent_reads(
        target["seq"], reads["file_reads"], target["rng"], reads["mean"],
        reads["sd"], reads["lo"], reads["hi"], reads["err"])]


def sample(reads: dict, target: dict, n: int, rng, first: int = 0):
    return gen.reads_of_lengths(target["seq"], target["lengths"][:n], rng,
                                reads["err"], first)
