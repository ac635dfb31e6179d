"""NHWC layer functions, resize and LSTM over PyTorch tensors."""
