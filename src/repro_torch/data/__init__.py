from repro_torch.data.synthetic import (SyntheticLM, SyntheticVision,
                                        make_worker_batches)

__all__ = ["SyntheticLM", "SyntheticVision", "make_worker_batches"]
