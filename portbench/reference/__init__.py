"""The plain reference the benchmark holds the system to: plain PyTorch that
imports nothing of the system under test (nor JAX), and builds its model,
scene and contacts from the configuration itself."""
