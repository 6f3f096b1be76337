"""Host I/O through the C++ runtime library `native/libeig_native.so` (the
checkpoint store, the VTK writer), each with a pure-Python writer of the
same bytes for when the library does not load."""
