"""Logical axis vocabulary (a copy of ``src/repro/sharding/axes.py``).

Every parameter / activation dimension in the framework is annotated with a
*logical* axis name; the sharding rules map logical names onto mesh
axes.  This is the X-HEEP "memory addressing mode" analogue: the same model
code serves contiguous (bank-local) and interleaved (bandwidth-oriented)
layouts purely through the rule table.
"""

from __future__ import annotations

# -- activation axes ---------------------------------------------------------
BATCH = "batch"          # global batch                  -> data (+ pod)
SEQ = "seq"              # sequence / time               -> sequence parallel
DECODE_BATCH = "decode_batch"  # serving batch           -> data (+ pod)
CACHE_SEQ = "cache_seq"  # KV-cache sequence axis

# -- parameter axes ----------------------------------------------------------
EMBED = "embed"          # d_model
MLP = "mlp"              # d_ff (tensor-parallel)
HEADS = "heads"          # query heads
KV_HEADS = "kv_heads"    # key/value heads (GQA)
HEAD_DIM = "head_dim"    # per-head width
VOCAB = "vocab"          # embedding / logits vocabulary
EXPERT = "expert"        # MoE expert axis (expert-parallel)
CONV = "conv"            # short conv kernel width (mamba/griffin)
STATE = "state"          # SSM state dim
RNN_WIDTH = "rnn_width"  # RG-LRU recurrent width
LAYERS = "layers"        # stacked-scan layer axis — never sharded
FSDP = "fsdp"            # alias attached to the largest param dim for ZeRO sharding

# Axes that must never be partitioned (scan carries, small dims).
UNSHARDED = (LAYERS, CONV, HEAD_DIM, STATE)
