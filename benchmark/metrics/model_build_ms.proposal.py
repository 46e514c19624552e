"""Model builder (models/builder.py): the harness's span around the call
that builds the request's ClusterState from its host columns, summed over
the window and divided by its requests, in ms."""


def read(run):
    b = [r["build_s"] for r in run.records if "build_s" in r]
    return 1e3 * sum(b) / len(b) if b else None
