"""Hand-written CUDA kernels for the engine's hot spots (Hopper, sm_90a).

Each kernel package has ``csrc/*.cu`` (the kernel and a plain C launch
function), ``ops.py`` (the engine-facing wrapper, its plain torch version
and its launch counter) and ``ref.py`` (a pure oracle).  ``build.py``
compiles the sources with ``nvcc`` at first use; nothing is built when a
module is imported.
"""
