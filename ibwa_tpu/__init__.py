"""ibwa_tpu — an iterative read-alignment framework with a JAX device engine.

A from-scratch re-design of the iBWA pipeline (BWT/FM-index short-read
alignment with iterative multi-reference remapping) for accelerators:

* compute path: JAX / XLA programs over device meshes
* host path:    C++ native library (suffix sort, sequential walks, RNG
                parity helpers) bound via ctypes + NumPy glue

Reference behavior contract: genome/ibwa (BWA 0.5.9 fork). File formats and
output semantics are kept bit-compatible so differential tests against the
reference binary validate every stage.
"""

__version__ = "0.1.0"
