"""Nodes of the graph a step replays (`graphs.py`): its top-level nodes and
those of its WHILE and IF bodies (`FrameGraphs.stats()["frame"]`,
`BatchedGraphs.stats()["batch"]`)."""


def read(run):
    return run.record.graph_nodes
