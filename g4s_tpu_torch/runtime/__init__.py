"""The port's runtime (counterpart of g4s_tpu/runtime): the native host
kernels and their ctypes loader (native_lib), and the C embedding API
(capi_impl, native/capi.c)."""
