"""rows_per_s: the input rows of every query completed in the window (a
group-by its table's rows, a join both tables' rows) over the whole
window."""


def read(w):
    if w.seconds <= 0 or not w.latencies:
        return None
    return w.rows / w.seconds
