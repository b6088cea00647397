"""The plain reference the benchmark holds the program to.

Plain PyTorch (f64 by default) written from DeePMD-kit's published
equations, independent of the package under test: it imports nothing of
it, and it is given only what the benchmark generates (coordinates, box
lengths, types, raw weights, the initial MD state). It works out its own
neighbour lists, its own davg/dstd, and its own forces and virial.
"""
