"""Hand-written Hopper (sm_90a) kernels: ctypes wrappers over `csrc/*.cu`,
their plain-torch versions, and the nvcc build (`hopper.build`).  Nothing
is compiled at import time."""
