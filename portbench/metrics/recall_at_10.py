"""Over every answer the run judged, the share of the reference's exact
top-10 found in the program's top-10."""


def read(run):
    return run.numbers.get("recall_at_10")
