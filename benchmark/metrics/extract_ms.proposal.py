"""Proposal diff (analyzer/proposals.py): the optimizer's timing record's
`host_extract_s`, a host clock around the diff of the placements into
proposals, summed over the window and divided by its proposals, in ms."""


def read(run):
    x = [r["host_extract_s"] for r in run.records if r.get("host_extract_s") is not None]
    return 1e3 * sum(x) / len(x) if x else None
