"""Serving helpers of the port: int8 weight-only quantization
(:mod:`.quantize`; on a mesh :func:`shard_quantized`, and
:func:`abstract_quantized` for the dry run).  The serving entry points
themselves are :func:`repro_torch.models.prefill` and
:func:`repro_torch.models.decode_step` (``quantized=True`` for an int8
model)."""

from .quantize import (QuantizedModel, abstract_quantized, dequantize,
                       quantization_error, quantize_params, shard_quantized)

__all__ = ["QuantizedModel", "abstract_quantized", "dequantize",
           "quantization_error", "quantize_params", "shard_quantized"]
