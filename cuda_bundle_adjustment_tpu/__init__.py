"""Bundle-adjustment / graph-optimisation engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
KudanLimited/cuda-bundle-adjustment (g2o-style ``BlockSolver_6_3``
Levenberg-Marquardt for Visual SLAM): SE3-expmap pose vertices, 3D landmark
vertices, mono/stereo/depth projection edges, point-to-line/point-to-plane ICP
edges, robust kernels, outlier thresholding, Schur-complement reduction and a
batched LM outer loop — built statically-shaped and sort-based (no atomics
on the single-device path), scaling over device meshes with ``shard_map``
collectives.

Quick start::

    import cuda_bundle_adjustment_tpu as tba

    opt = tba.TpuGraphOptimisation.create()
    poses = tba.PoseVertexSet();  landmarks = tba.LandmarkVertexSet()
    ...
    opt.add_vertex_set(poses); opt.add_vertex_set(landmarks)
    opt.add_edge_set(mono_edges)
    opt.initialize()
    opt.optimize(10)
"""

from .graph import (
    Camera,
    GraphOptimisationOptions,
    LandmarkVertex,
    LandmarkVertexSet,
    PoseVertex,
    PoseVertexSet,
    Se3,
)
from .models import (
    DepthEdge,
    DepthEdgeSet,
    LineEdge,
    LineEdgeSet,
    MonoEdge,
    MonoEdgeSet,
    PlaneEdge,
    PlaneEdgeSet,
    PointToLineMatch,
    PointToPlaneMatch,
    StereoEdge,
    StereoEdgeSet,
)
from .ops.robust import RobustKernelType
from .optimizer import TpuGraphOptimisation, TpuGraphOptimisationImpl

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "GraphOptimisationOptions",
    "Se3",
    "PoseVertex",
    "LandmarkVertex",
    "PoseVertexSet",
    "LandmarkVertexSet",
    "MonoEdge",
    "MonoEdgeSet",
    "StereoEdge",
    "StereoEdgeSet",
    "DepthEdge",
    "DepthEdgeSet",
    "LineEdge",
    "LineEdgeSet",
    "PlaneEdge",
    "PlaneEdgeSet",
    "PointToLineMatch",
    "PointToPlaneMatch",
    "RobustKernelType",
    "TpuGraphOptimisation",
    "TpuGraphOptimisationImpl",
]
