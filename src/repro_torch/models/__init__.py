"""Model code of the port: layers, MLP, attention (serving subset) and the
dense-attention LM serving entry points."""
