"""Questions, one module a question, found by the names a cell file lists.

Each module is the client of one db-benchmark question: ``run(att, tables,
config)`` asks it of ``arrow_tpu_torch`` (imported as `att`) through the
public API, as a user would, and returns the result as a RecordBatch that
stays on the device.  ``OPERATOR`` names the operator whose span the call
is ("groupby" or "join"), ``TABLES`` the tables it reads, and ``READS`` the
columns of each that the least bytes count as read once ("*": all)."""
