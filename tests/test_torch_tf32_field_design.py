"""The 3xTF32 design of the f32 field forward's products against the JAX package in
f64, beside one TF32 product and one accumulator a layer (the designs
and the check: tests/_tf32_designs.py). ``-s`` prints each design's error
against f64 beside plain f32's."""

import pytest

import _tf32_designs as D


@pytest.mark.parametrize("design", list(D.DESIGNS))
def test_field_design_is_as_close_to_f64_as_f32(design, capsys):
    D.field_design_is_as_close_to_f64_as_f32(design, capsys)
