"""polychordlite_tpu — a nested-sampling framework on JAX/XLA.

A from-scratch JAX/XLA re-architecture with the capabilities of
PolyChordLite v1.22.2 (Bayesian evidence + posterior sampling via whitened
slice sampling with multimodal KNN clustering), built for accelerators:
batched slice-chain ensembles on the device mesh, float64 administrator
bookkeeping on the host, pypolychord-compatible API and output files.
"""

__version__ = "0.1.0"

from .models.graded import GradedLikelihood
from .output import PolyChordOutput
from .run import run, run_polychord
from .settings import PolyChordSettings

__all__ = [
    "GradedLikelihood",
    "run",
    "run_polychord",
    "PolyChordSettings",
    "PolyChordOutput",
    "__version__",
]
