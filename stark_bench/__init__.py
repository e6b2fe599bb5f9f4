"""The benchmark of hodor_tpu_torch: verified VDF proofs on one H100.

    python -m stark_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

README.md says how to run a cell and how to add a configuration, a
traffic mix or a metric as files of their own.
"""
