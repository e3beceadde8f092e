"""Exclusive ms of the tree-top library LU (the stage timer's
``treetop_lu``) in the refactor recorded after the window."""


def read(run):
    if not run.card or run.stages is None:
        return None
    return run.stages["excl"].get("treetop_lu") or None
