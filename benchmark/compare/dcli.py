"""The comparison of the dcli entry: the cli entry's (compare/cli.py),
its checks and its control alike, on the merged SAM of each call, which
`dcli align` + `dcli merge` promise to write byte for byte as ssw_test
does."""

from benchmark.plugins import plugin

_cli = plugin("compare", "cli")
compare = _cli.compare
plant_control = _cli.plant_control
