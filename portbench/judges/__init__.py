"""The comparisons that decide ``correct``, one module an operator, found by
the name that a question's ``OPERATOR`` gives.  Each has
``compare(program, reference) -> {number: value}``: both sides as {column:
values} with int64 or float64 values; each number is held to the limit of
the same name in the configuration's ``limits``, and 0 is a match."""
