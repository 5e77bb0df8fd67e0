"""One module per entry point the cells drive, named by a traffic file's
``driver``; each has ``run(cell) -> dict``."""
