"""Host-side numpy data layer of the PyTorch port (copies of the JAX
package's PMR loader and featurizer, tokenizers, chunker, collate and batch
iterator)."""
