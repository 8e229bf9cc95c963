"""Host-side native code: the C++ OBJ line parser (``objparse_native``)."""
