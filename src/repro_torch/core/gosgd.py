"""GoSGD baseline (Blot et al., 2019): randomized push-sum gossip SGD with
whole-model (block) messages applied at the next iteration boundary; port
of ``repro/core/gosgd.py``, LayUp's block mode."""
from repro_torch.core.api import register_algorithm
from repro_torch.core.layup import LayUp


@register_algorithm("gosgd")
def _gosgd():
    return LayUp(layerwise=False, name="gosgd")
