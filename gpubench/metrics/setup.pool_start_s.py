"""setup.pool_start_s: seconds of the set-up step that the benchmark times around
the call into the program (run.py, set-up steps 2-3)."""


def read(rec):
    return rec["setup"].get("pool_start_s")
