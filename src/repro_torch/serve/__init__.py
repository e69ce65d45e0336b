"""Serving helpers of the port: int8 weight-only quantization
(:mod:`.quantize`).  The serving entry points themselves are
:func:`repro_torch.models.prefill` and :func:`repro_torch.models.decode_step`
(``quantized=True`` for an int8 model)."""

from .quantize import (QuantizedModel, dequantize, quantization_error,
                       quantize_params)

__all__ = ["QuantizedModel", "dequantize", "quantization_error",
           "quantize_params"]
