"""The benchmark of easevoice_trainer_tpu_torch: ``python3 evbench/run.py``."""
