"""qbmx — accelerator-native Quantum Boltzmann Machine image classification.

A brand-new JAX/XLA/Pallas framework with the capabilities of the reference
QBM-Image-Classification codebase (see SURVEY.md): discriminative RBMs,
flat discriminative QBMs and convolutional-deep QBMs trained with
clamped/unclamped two-phase Boltzmann learning over QUBO samples, with the
D-Wave annealer / dwave-neal simulated annealing replaced by on-device
samplers (batched simulated annealing in pure JAX and as a Pallas GPU
kernel, block Gibbs, and an exact-enumeration oracle).

Layout:
  qbmx.core      — QUBO/Ising containers and energy math
  qbmx.samplers  — SA (JAX + Pallas), Gibbs, Boltzmann, exact oracle
  qbmx.models    — rbm / dqbm / cdqbm model families
  qbmx.train     — training loops, moment estimation, history
  qbmx.data      — dataset loaders, preprocessing, coreset selection
  qbmx.parallel  — device-mesh sharding of chains/batch, psum reductions
  qbmx.utils     — metrics, checkpointing
  qbmx.cli       — rbm_main / qbm_main / cdqbm_main entry points
"""

__version__ = "0.1.0"
