"""The plain reference: brute-force ray-triangle tests and tree checks
in plain PyTorch. It imports nothing of the program (`bvh_tpu_torch`)
and takes nothing the program made: it works from the benchmark's own
triangles and rays, and reads the program's outputs only to judge them.
"""
