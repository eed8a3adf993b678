"""The plain reference: simple_tag, the MF-VAE model, its ELBO step
under Adam and the run's random streams, in plain PyTorch (float32, TF32
off), importing nothing of the program."""
