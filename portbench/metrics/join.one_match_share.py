"""join.one_match_share: the share of the traced queries' joins (``att.join``
spans) whose emit was the one-match emit (an ``att.join.one_match`` span
inside).  None without a complete trace, without a join, and where the
program's merge emit reads no ``join_counts`` (an ``att.sync.join_counts``
span): a program without the one-match emit."""


def read(w):
    t = w.trace
    if t is None or not w.trace_complete or not t.queries.ops:
        return None
    inside = [o for o in t.host if o.name.startswith("att.") and t.queries.find(o.start) is not None]
    joins = [o for o in inside if o.name == "att.join"]
    if not joins or not any(o.name == "att.sync.join_counts" for o in inside):
        return None
    starts = [o.start for o in inside if o.name == "att.join.one_match"]
    held = sum(any(j.start <= s <= j.end for s in starts) for j in joins)
    return 100.0 * held / len(joins)
