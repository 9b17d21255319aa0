"""Attention kernels of the port: plain versions (``ref``), CUDA kernels
(``decode_attention``, ``flash_attention``, sources in ``../csrc``), the
``nvcc`` build step (``_build``) and the device-dispatching ``ops``."""
