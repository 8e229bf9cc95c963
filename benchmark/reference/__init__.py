"""The benchmark's yardstick: frozen meshes, the plain reference renderer,
the comparison and the bound arithmetic. Imports neither JAX nor anything
of the program."""
