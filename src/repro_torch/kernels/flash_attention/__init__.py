"""Flash attention: the cacheless full-sequence forward's online-softmax
attention."""
