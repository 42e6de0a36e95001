"""The port's fuzz harnesses (the JAX repository's `fuzz/`).

- `fuzz_differential.py`: seeded random and mutated inputs through the
  seven entry points, on several ways of running each call that must
  agree (a card context and a CPU context, the native tier and
  LWKZG_NATIVE=0, the card's pairing and the host tier); every
  rejection must be a clean `KZGError` (`SetupLoadError` for the
  loader).
- `gen_corpus.py`: the seed corpora of the C harness, from the
  consensus vectors and from a port context at the degree-4 size.
- `fuzz_capi.c`: the C harness against the port's C ABI
  (`capi/c_kzg_4844.h`), built by `capi.build_fuzz`: the combined
  first-byte target, six dedicated targets, and a replay mode for gcc.
"""
