from repro_torch.data.pipeline import ShardedIterator
from repro_torch.data.synthetic import (SyntheticLM, SyntheticVision,
                                        make_worker_batches)

__all__ = ["ShardedIterator", "SyntheticLM", "SyntheticVision",
           "make_worker_batches"]
