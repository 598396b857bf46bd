"""One driver per traffic kind: ``<kind>.py`` holds its ``Driver``, found
by the ``kind`` a traffic mix's file names."""
