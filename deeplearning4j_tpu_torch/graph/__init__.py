"""Graph embeddings (counterpart: ``deeplearning4j_tpu/graph``; ref:
deeplearning4j-graph): the graph, random walks, DeepWalk."""
from deeplearning4j_tpu_torch.graph.graph import Graph
from deeplearning4j_tpu_torch.graph.walker import RandomWalkIterator, generate_walks
from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk, GraphVectors

__all__ = ["Graph", "RandomWalkIterator", "generate_walks", "DeepWalk",
           "GraphVectors"]
