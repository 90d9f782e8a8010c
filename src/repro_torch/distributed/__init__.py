"""Gradient compression for data-parallel reduction."""
