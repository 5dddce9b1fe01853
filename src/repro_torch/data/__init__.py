# Data: the paper's synthetic benchmark types and scenario corpus
# (``synth``), and the training input pipeline over Lance files
# (``loader``).

from .loader import TokenLoader, write_token_file  # noqa: F401
from .synth import PAPER_TYPES, SCENARIOS, paper_type, scenario, token_corpus  # noqa: F401
