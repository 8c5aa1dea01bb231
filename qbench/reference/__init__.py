"""The plain reference that decides ``correct``: the exact top-k in
float64 and the comparison of a run's answers with it. Plain PyTorch; it
imports nothing of the program and reads nothing the program made."""
