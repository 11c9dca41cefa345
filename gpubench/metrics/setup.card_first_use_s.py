"""setup.card_first_use_s: seconds of the set-up step that the benchmark times around
the call into the program (run.py, set-up steps 2-3)."""


def read(rec):
    return rec["setup"].get("card_first_use_s")
