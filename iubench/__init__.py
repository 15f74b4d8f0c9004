"""The benchmark of ``interpolate_unstructured_tpu_torch`` on a CUDA card:
``python3 iubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (see ``run.py`` and ``harness.py``)."""
