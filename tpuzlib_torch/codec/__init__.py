"""The host DEFLATE codec: constants and Huffman tables, the bit sink,
the host deflate engine (tokenizer, block choice, Huffman coding and the
native chunk emit) and the host inflate engine (tokenize, the serial
engine, the token expansion)."""
