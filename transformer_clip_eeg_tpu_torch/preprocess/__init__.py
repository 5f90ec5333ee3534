"""preprocess of the torch package: wav2vec2 stimulus feature extraction."""
