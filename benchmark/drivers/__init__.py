"""One module per entry into the program, named by a configuration's
``driver``; each has ``run(ctx) -> dict`` (see ``run.py``)."""
