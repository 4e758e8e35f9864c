"""Compute ops: closed-form samplers, batched intersection, BVH build/traverse.

These are the [KERNEL]-tagged hot-path components of SURVEY.md §2 re-designed
for wide data-parallel hardware: brute-force sphere intersection is one fused
closest-hit reduction per bounce, and BVH traversal is a stackless lockstep
loop.
"""
