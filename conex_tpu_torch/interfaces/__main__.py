"""python3 -m conex_tpu_torch.interfaces: build the C ABI's library and
print the paths a C or MATLAB caller needs."""

from . import HEADER, STABLE_LIBRARY, build

build()
print(f"library {STABLE_LIBRARY}")
print(f"header {HEADER}")
