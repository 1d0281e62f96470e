"""The benchmark's plain reference: what `correct` is judged against.

Plain NumPy and the standard library only.  It imports nothing of the
program under test, of `jax` or of the JAX package, and it takes nothing
the program made: it reads a communication DAG as raw arrays (`RawDag`,
the job's tasks, dependencies and cluster as given) and works out every
derived quantity itself.

  dag     the raw DAG and its plain views (pod pairs, NIC classes, order)
  des     a frozen copy of the plain discrete-event simulator (fluid model,
          weighted max-min fair sharing), at float64, float32 or bfloat16
  xbound  a frozen copy of Alg. 2's capacity bound on the bitset closure
"""
