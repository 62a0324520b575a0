"""Models of the port: the Llama decoder (``llama``), the BERT encoder for
/embed (``bert``), the Whisper encoder-decoder for ASR (``whisper``), the
HF-layout checkpoint loaders (``hf_import``, ``whisper_import``) and the
params bridge from the JAX package (``convert``)."""
