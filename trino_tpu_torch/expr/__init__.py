"""Expressions: IR, the scalar function registry, the page compiler."""
