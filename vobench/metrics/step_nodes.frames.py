"""step_nodes.frames: the device nodes of one replay of the step graph
(StepGraph.count_nodes, cuGraphGetNodes; the largest shard on a mesh)."""


def read(run):
    return run.get("nodes")
