"""Host-side numpy data layer of the PyTorch port (copies of the JAX
package's featurizer, tokenizers, chunker and collate)."""
