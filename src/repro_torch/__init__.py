"""repro_torch: the PyTorch/CUDA port of ``repro`` (MorphingDB, a
task-centric AI-native DBMS), for one NVIDIA H100.

Port of ``src/repro/__init__.py``. The package mirrors ``repro`` module
for module and imports neither ``jax`` nor anything of ``repro``. Ported
so far (the task-centric query path, its serving and dispatch tiers, LM
serving and training on one card):

- ``engine``    — MiniSQL parser, logical plan + optimizer (Eq. 10/11
  placement with ``"cuda"`` as the device), ``MorphingSession``, the
  share-aware serving lanes (``MorphingServer``) and the multi-process
  dispatch tier (``DispatchServer``);
- ``core``      — task-centric model selection (NMF subspace in torch,
  two-phase ``ModelSelector``, ``TaskRegistry``, the mini zoo);
- ``pipeline``  — operator DAG, cost model, ``TorchBackend``, batchers,
  share cache and the chunked ``PipelineExecutor``;
- ``storage``   — BLOB / decoupled stores, catalog, Mvec format,
  checkpoints;
- ``configs``   — the LM zoo's model configs and registry;
- ``models``    — the decoder-only LM (dense, MoE, SSM, hybrid) and the
  encoder-decoder backbone: prefill, decode over full or circular KV
  caches, loss;
- ``training``  — AdamW, train / eval / prefill / serve step functions,
  fault injection and restartable training control;
- ``data``      — the synthetic and file-sharded token corpora;
- ``launch``    — the serving launcher (``ServingEngine``) and the
  training launcher;
- ``kernels``   — hand-written CUDA kernels for Hopper (``fused_embed``,
  ``rmsnorm``, ``flash_attention``, ``decode_attention``) with their
  plain PyTorch versions;
- ``convert``   — carries zoo weights, LM params and AdamW state across
  from the reference.

Entry points run on ``cuda`` unless the caller asks for the CPU.
"""
__version__ = "0.1.0"
