"""Share of the window in the CLI's own parsing: self time of the spans
cli.header (the @SQ pass over the target file), cli.parse_target (FASTA
parse and encode of the targets) and cli.reads (FASTQ parse, encode,
reverse complement), from the program's spans."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx, ("cli.header", "cli.parse_target", "cli.reads"),
                       "self")
