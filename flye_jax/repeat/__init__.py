from flye_jax.repeat.graph import RepeatGraph, GraphEdge, GraphNode, EdgeSequence
