"""Model building blocks: embedding engine, DNN tower, CIN, and kernels."""
