"""The plain reference: one module a question, with ``run(config, tables,
lower=False)`` over the benchmark's own generated tables ({table: {column:
tensor}}), returning {column: tensor} of values (int64 or float64).

Plain PyTorch, independent of the program: nothing here imports
``arrow_tpu_torch``.  ``lower=True`` computes one precision below the
configuration's (float32 for float64, int16 for 32-bit integers): the
control that the comparison has to fail."""
