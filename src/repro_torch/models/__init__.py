# Models: the LM substrate's serving half (every family's prefill and
# decode), the registry's builder and analytic counts, and the converter
# between the JAX reference's param/cache layout and the port's.

from .registry import build_model, model_flops, param_counts, supports_shape  # noqa: F401
from .transformer import LMModel  # noqa: F401
