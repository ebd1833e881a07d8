"""Int8 block-quantized gradient compression: a re-export of the tree
codecs of ``repro_torch.core.compress`` (port of ``repro.optim.compress``),
the same objects, so optimizer-side callers keep importing from here."""
from repro_torch.core.compress import (  # noqa: F401
    BLOCK,
    compress_tree,
    decompress_tree,
    dequantize,
    init_error_state,
    quantize,
    wire_bytes,
)

__all__ = ["BLOCK", "quantize", "dequantize", "init_error_state",
           "compress_tree", "decompress_tree", "wire_bytes"]
