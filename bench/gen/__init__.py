"""Input generators, one module per ``generator`` name of a
configuration file: ``generate(cfg, seed, device) -> (src, dst, n)``,
each undirected edge once as generated, int64 on ``device``."""
