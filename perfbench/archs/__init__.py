"""What a configuration's model is to the benchmark.

A configuration file (``perfbench/configs/*.json``) names, under its key
``"arch"``, a Python file by its path from the repository's root, such as
``"perfbench/archs/transformer.py"``. The harness loads that file once a
cell (``harness.cell``: ``c.arch``) and takes from it every piece that
depends on the model's architecture. ``cfg`` is the configuration file's
dict throughout. The file defines:

- ``layout(cfg) -> perfbench.weights.Layout``: leaf path -> (shape, std)
  of every weight, the program's parameter layout; ``weights.make`` draws
  the tree from it, and both the program and the reference take that tree;
- ``loss(cfg, w32, tokens, mm)``: the float32 reference's mean training
  loss over ``tokens`` [B, S] from the float32 leaves ``w32``, with every
  matrix product through ``mm`` (``reference.matmul_for``);
  ``reference.train`` runs AdamW over it;
- ``Forward(cfg, weights, precision="f32")``, whose
  ``.logits(tokens, positions=None)`` gives the reference's float32
  logits over the real vocabulary;
- ``train_step_flops(cfg, rows, seq)`` and
  ``serve_call_flops(cfg, rows, length, gen_tokens)``: the model FLOPs of
  a train step and of a generate call;
- ``flash_call(cfg, rows, length)`` and ``decode_call(cfg, rows, index)``:
  (operations, bytes) of one attention kernel call; a model without such
  a kernel leaves them out;
- ``smoke(cfg) -> cfg``: the model keys of the CPU rehearsal's cut
  (``perfbench.rehearsal``), a few layers at narrow widths.

The metrics read the counts through ``ctx.flops``: the file's names over
those of ``perfbench.flops``. A metric whose reader needs a function the
file lacks reads nothing in that cell.

The generic parts are imported, never copied: ``perfbench.reference``
(``full_f32``, ``matmul_for``, ``rmsnorm``, ``rope``, ``lr_at``, ``F32``),
``perfbench.weights`` (``Layout``, ``leaves``) and ``perfbench.flops``
(``attention_pairs``, ``decode_keys``, ``bound_seconds``, ``head_dim``,
``padded_vocab``); a file may import another's pieces, as a variant of
``transformer.py`` imports its ``moe`` or ``attention``. So a new
architecture enters the benchmark as new files: its configuration, this
module, and its traffic, limits and metrics.
"""

# what every file must define (``flash_call`` and ``decode_call`` may be
# absent)
INTERFACE = ("layout", "loss", "Forward", "train_step_flops",
             "serve_call_flops", "smoke")
