"""Quantization core: the paper's affine quantizer and the int pack."""
