"""The native host library: C++ sources (src/) and their ctypes bindings."""
