"""Recording generators, one module a kind, named by a configuration's
``input.kind``; each has ``make(config, count, seed, device)``."""
