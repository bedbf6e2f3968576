"""The plain reference the correctness check judges answers by.

Plain PyTorch in float64; it imports nothing of the port and takes
nothing the port made except the answers it judges."""
