"""The plain reference of the benchmark's check: the SIREN, the hard
boundary conditions of a box, the phase fits' targets, Adam and the head
solve, the divergence grid and the cosine-transform pressure solve,
written in plain PyTorch and NumPy from the published method. It imports
nothing of the program and takes none of its tables."""
