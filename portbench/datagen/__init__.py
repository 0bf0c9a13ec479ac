"""Table generators, one module a generator, found by the name a
configuration file gives under ``"generator"``.  Each has ``make(config,
tables, seed, device)``, returning ``{table: {column: tensor}}`` for the
tables named, made on `device` from `seed`."""
