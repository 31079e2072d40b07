// KB page: upload / list / delete documents (reference pages/kb.py:31).
const fileInput = document.getElementById("file-input");
const uploadBtn = document.getElementById("upload-btn");
const uploadStatus = document.getElementById("upload-status");
const fileList = document.getElementById("file-list");
const listStatus = document.getElementById("list-status");

async function refresh() {
  listStatus.textContent = "loading…";
  try {
    const resp = await fetch("/api/documents");
    const body = await resp.json();
    fileList.innerHTML = "";
    (body.documents || []).forEach((name) => {
      const li = document.createElement("li");
      const span = document.createElement("span");
      span.textContent = name;
      const btn = document.createElement("button");
      btn.textContent = "Delete";
      btn.addEventListener("click", async () => {
        btn.disabled = true;
        await fetch("/api/documents?filename=" + encodeURIComponent(name),
                    { method: "DELETE" });
        refresh();
      });
      li.appendChild(span);
      li.appendChild(btn);
      fileList.appendChild(li);
    });
    listStatus.textContent = (body.documents || []).length
      ? "" : "no documents uploaded yet";
  } catch (e) {
    listStatus.textContent = "failed to list documents: " + e;
  }
}

uploadBtn.addEventListener("click", async () => {
  if (!fileInput.files.length) {
    uploadStatus.textContent = "choose a file first";
    return;
  }
  uploadBtn.disabled = true;
  for (const f of fileInput.files) {
    uploadStatus.textContent = "uploading " + f.name + "…";
    const fd = new FormData();
    fd.append("file", f);
    try {
      const resp = await fetch("/api/documents", { method: "POST", body: fd });
      const body = await resp.json();
      uploadStatus.textContent = body.message || resp.statusText;
    } catch (e) {
      uploadStatus.textContent = "upload failed: " + e;
    }
  }
  uploadBtn.disabled = false;
  fileInput.value = "";
  refresh();
});

refresh();
