"""The paper's primary contribution: CacheGenius.

Semantic-aware classified storage (K-means over CLIP embeddings → per-node
VDBs), request scheduling by prompt/node-centroid similarity, the hybrid
generation policy of Algorithm 1 (direct-return / image-to-image /
text-to-image by composite similarity score), and the LCU cache-maintenance
policy of Algorithm 2.
"""
from repro_torch.core.kmeans import kmeans_fit, kmeans_assign  # noqa: F401
from repro_torch.core.vdb import VectorDB  # noqa: F401
from repro_torch.core.policy import GenerationPolicy, Route  # noqa: F401
from repro_torch.core.lcu import (  # noqa: F401
    EvictionPolicy, LCUPolicy, LRUPolicy, LFUPolicy, FIFOPolicy,
)
from repro_torch.core.scheduler import RequestScheduler  # noqa: F401
from repro_torch.core.storage_classifier import StorageClassifier  # noqa: F401
from repro_torch.core.latency_model import LatencyModel, CostModel  # noqa: F401
from repro_torch.core.system import CacheGenius  # noqa: F401
