"""The plain reference that decides ``correct``.

Plain PyTorch, written from the rod's equations and the trainer's
published recipe (reference repo: cosserat_ode.py, knode.py,
physics_train.py, train_segment.py of hsiehScalAR/KNODE-Cosserat):

- ``rod``: the rod's derived constants, the semi-discretized Cosserat RHS,
  the Euler spatial sweep, the BDF-2 forward-difference Newton-shooting
  step, the rollout and the KNODE MLP;
- ``train``: the teacher-forced one-step loss and the Adam(W) chain with
  reduce-on-plateau and the non-negative weight clamp.

It imports nothing of the program under test and takes none of its
derived tensors: it works the rod's constants, the cells, the initial
weights of a training run and every solve out again from the inputs the
benchmark hands to both sides.

Every matrix product goes through :func:`rod.mm`, so the whole reference
can be computed in float64 (the judge), float32, or float32 with TF32
products (the control: operands rounded to TF32's 10-bit mantissa, as the
tensor cores take them).
"""
