"""Training substrate: AdamW in the reference's arithmetic, the int8
error-feedback gradient compressor, the microbatched train step."""
