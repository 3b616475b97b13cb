"""The paper's own experiment (Sec. 4): K=32 agents, fully-connected,
d=10 linear regression, sigma_v^2 = 0.01, step-size mu, REF-Diffusion
with Tukey MM aggregation vs mean / median baselines."""

NUM_AGENTS = 32
DIM = 10
NOISE_VAR = 0.01
STEP_SIZE = 0.05
NUM_ITERS = 1000
DELTA_GRID = (0.0, 1.0, 10.0, 100.0, 1000.0)
RATE_GRID = (1, 3, 7, 11, 15)   # num malicious of 32, fixed delta=1000
