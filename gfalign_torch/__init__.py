"""gfalign_torch: the PyTorch/CUDA port of gfalign_tpu.

It runs on an NVIDIA H100 (sm_90a) and keeps the JAX package's module
layout, so each module's counterpart sits under the same path there.  It
imports torch, numpy and the standard library only, never jax or
gfalign_tpu.

Subpackages
-----------
io        GFA, GAF and FASTA/FASTQ parsing, writers, the ctypes bindings of
          the native host runtime (io/native.py) and its GAF cache
native    the C++ host runtime's source, built with g++ at first use
graph     graph model, name<->id vocab, adjacency, assembly statistics
ops       NW path scoring and Smith-Waterman read scoring: plain PyTorch
          versions and the CUDA kernels
engine    align (seeding, graph aligner), search, evalPath, evalGFA,
          alignment-set operations
parallel  the frontier scoring step; a single-process distribution stub
cli       drop-in command-line surface mirroring the reference's flags
"""

__version__ = "0.1.0"
