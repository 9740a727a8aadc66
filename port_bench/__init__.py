"""The benchmark of the PyTorch/CUDA port (`nerf_from_image_tpu_torch`) on
one NVIDIA H100.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once (see run.py); `port_bench.control`
takes the readings the limits of `correct` are set from; `python -m
pytest port_bench/tests` runs the benchmark's own tests (those marked
`card` need the card). Nothing here imports JAX or the JAX package, and
`reference/` imports nothing of the program.
"""
