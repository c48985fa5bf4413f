"""Quantization (counterpart of ``paddle_tpu/quant``): weight-only int8 /
int4 quantization with its fused dequant-matmul kernel, and the GPTQ and
AWQ passes that choose the codes. PTQ with activation observers, QAT and
W8A8 come with a later slice."""
from .gptq_awq import (AWQLinear, awq_quantize_model, awq_search_scale,
                       capture_linear_inputs, gptq_quantize_model,
                       gptq_quantize_weight)
from .weight_only import (QuantizedLinear, dequantize_weight,
                          linear_quant_meta, pack_int4, quantize_blockwise,
                          quantize_model, weight_only_linear)

__all__ = ["AWQLinear", "awq_quantize_model", "awq_search_scale",
           "capture_linear_inputs", "gptq_quantize_model",
           "gptq_quantize_weight", "QuantizedLinear", "dequantize_weight",
           "linear_quant_meta",
           "pack_int4", "quantize_blockwise", "quantize_model",
           "weight_only_linear"]
