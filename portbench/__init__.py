"""The benchmark of ``arrow_tpu_torch``: H2O.ai db-benchmark group-by and
join questions at 1e8 rows on one card.  ``python3 portbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` runs one cell
once; see README.md."""
