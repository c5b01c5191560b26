"""Solver vocabulary and the mu epilogue."""
