"""The benchmark's plain reference: the port's plain PyTorch paths,
frozen at commit f23bdf43188a706ad63894c8fbc54bba723997d0 of this
repository, with its imports pointed here.

Departures from the program: no splat op (the reference renders with
`plane_splat=False`, so autograd differentiates the corner-packed
gather where the program runs its plane-gradient kernel), one process
(`parallel/mesh.py` is the world-size-1 behaviour), and only the parts
the benchmark's cells drive (no checkpoint readers, report files or
FID). It imports nothing of the program, of JAX or of the JAX package.
"""
