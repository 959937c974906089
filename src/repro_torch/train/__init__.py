"""The training path: AdamW and Adafactor (``optimizer``) and the
microbatched train step (``trainer``)."""
