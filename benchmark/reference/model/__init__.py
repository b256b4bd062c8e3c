"""A frozen copy of the port's plain float64 model: geometry, the SZ
operator, the X-ray projection, the profiles, priors and mass veto, and
the joint log-posterior (``models.joint.JointModel.log_like_batch``).
It imports nothing of the program: the benchmark's reference and the
forward model that makes its data stand on it, and a change to the
program cannot move it."""
