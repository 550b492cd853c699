"""Frozen operation and byte counts and the chip's published peaks.

The counts are functions of the shapes of the work and of the sweeps the
Newton solves of these inputs need, as the plain reference measures them
(``<workload>.json`` beside this file); they never read how the program
did the work, so a kernel that finds a cheaper path cannot shrink its own
yardstick. Each input byte is counted read once and each output byte
written once.
"""
