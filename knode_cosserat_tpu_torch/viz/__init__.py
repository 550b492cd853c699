"""Figures and animations (matplotlib, imported at use)."""
from .visualizer import (ContinuumRobotVisualizer, plot_2d,
                         plot_training_curves, tip_generalization_plot,
                         visualize_2d)
from .mocap import MocapPlayback
